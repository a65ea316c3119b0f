// Windowed first-k-valid selection and the fills built on it, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/window_fill.py.
//
// Replaces four TPU kernels of auvtpu/pallas/window_fill.py:
//   topk_full_kernel<.., false> <- _make_topk_full_kernel    (B2, pallas_topk_full)
//   topk_full_kernel<.., true>  <- _make_topk_kernel         (B4, pallas_topk_idx)
//   kriging_fill_kernel         <- _make_kriging_fill_kernel (B1, pallas_fill_kriging)
//   fill_tile_kernel<KIND, CPT> <- _make_fill_kernel         (B3, pallas_fill_idw /
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
// B1, B2 and B4 read one NaN-encoded plane (invalid and out-of-grid cells
// are NaN) that the wrapper builds, padded by R on every side so no read
// needs a bounds check.  B3 reads the elevation and validity planes as they
// are and builds the NaN-encoded halo of each tile in shared memory itself.
// Slots are written with selects, and B3 adds only the values it takes,
// never hit * (v - old) or 0 * v arithmetic: 0 * NaN is NaN.
//
// What bounds them on the H100.  With 10-20% of cells masked a scan for 4
// neighbours reads 4.4-5.0 table rows per cell, one for 8 about 10 (measured
// at the Kerguelen stand-in).  B2 writes 1+3k planes and B4 1+k: both are
// bound by the output writes to HBM.  B3 reads two planes, writes one and
// does a few operations per candidate: it is bound by those bytes.  B1
// writes one plane (two with the variance) and does ~100 multiply-adds, 21
// divides (gj), 10 square roots and 10 exps per cell, so it is bound by the
// throughput of the IEEE divides and transcendentals rather than by memory.
// B1, B2 and B4 do the simple thing: one thread per cell in 32x8 blocks,
// reads through the read-only data cache (__ldg) so a warp's 32
// neighbouring loads of one offset coalesce, the offset table read by all
// threads of a warp at the same index (a broadcast), all state in registers.
// B3 (fill_tile_kernel below) takes what they leave: no padded copy (its
// four extra launches cost about the kernel's time again), the scan's
// dependent loads served from shared memory, where they were L1/L2 round
// trips, and several cells a thread so that those loads overlap.  The price
// is a second plane read (valid beside elev, where the padded copy was one
// NaN-encoded plane).  Measured on the H100, the halo loads (2.6 reads a
// cell through L2 at R=10) and the scan's instructions, not DRAM, hold it
// near four times its bound.  B1, B2 and B4 could take the same loader.

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

// B3: first-k-valid IDW or mean over a halo tile in shared memory.  One
// block of FT_W x FT_TY threads fills an FT_W-column, TH = FT_TY*CPT-row tile
// of the output, CPT cells a thread (rows ty, ty + FT_TY, ...).  It reads the
// planes themselves (row pitches pe, pv: a window view of a larger mosaic is
// taken as it is), never a padded copy:
//   1. the (TH + 2R) x (FT_W + 2R) halo tile, NaN where a cell lies outside
//      the plane or valid <= 0.5 (a select).  Warp w loads tile rows w,
//      w + FT_TY, ..., FT_ROWS rows a batch, its lanes on adjacent columns
//      (coalesced), every load of a batch issued before any store: they are
//      L2 round trips, and one pair at a time left the block waiting on each;
//   2. the table as each row's offset within the tile, and its IDW weight
//      wtab[t] = 1/(d2^(p/2)+eps) rounded to float32 on the host
//      (window_fill.py:331-335);
//   3. per cell, the first k valid cells in table order; a thread's CPT
//      scans step through the table together, so their shared loads overlap
//      (every load of the tile is in range: the table's offsets are within
//      R).  Sums run in table order and add only the cells taken, as the
//      plain version adds them, so the two are bit-equal;
//   4. with `keep`, a cell with valid > 0.5 writes its own elev (the
//      streaming window's where(valid > 0.5, elev, fill)) and skips the scan.
constexpr int FT_W = 32;
constexpr int FT_TY = 8;
constexpr int FT_THREADS = FT_W * FT_TY;
constexpr int FT_ROWS = 4;  // tile rows a warp loads in one batch

template <int KIND, int CPT>
__global__ void __launch_bounds__(FT_THREADS)
fill_tile_kernel(const float* __restrict__ elev, int pe, const float* __restrict__ valid, int pv,
                 const int2* __restrict__ tab, const float* __restrict__ wtab, int m, int H, int W,
                 int R, int k, float eps, int keep, float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int TH = FT_TY * CPT;
  const int tw = FT_W + 2 * R;
  const int th = TH + 2 * R;
  float* tile = smem;
  int* soff = reinterpret_cast<int*>(tile + th * tw);
  float* sw = reinterpret_cast<float*>(soff + m);
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * FT_W;
  const int lane = threadIdx.x;

  for (int tc0 = 0; tc0 < tw; tc0 += 2 * FT_W) {
    for (int tr0 = threadIdx.y; tr0 < th; tr0 += FT_TY * FT_ROWS) {
      float e[FT_ROWS][2], va[FT_ROWS][2];
#pragma unroll
      for (int b = 0; b < FT_ROWS; ++b) {
        const int tr = tr0 + b * FT_TY;
        const int gr = r0 - R + tr;
        const bool row_in = tr < th && gr >= 0 && gr < H;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tc = tc0 + lane + h * FT_W;
          const int gc = c0 - R + tc;
          const bool in = row_in && tc < tw && gc >= 0 && gc < W;
          e[b][h] = in ? __ldg(elev + (size_t)gr * pe + gc) : 0.f;
          va[b][h] = in ? __ldg(valid + (size_t)gr * pv + gc) : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < FT_ROWS; ++b) {
        const int tr = tr0 + b * FT_TY;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tc = tc0 + lane + h * FT_W;
          if (tr < th && tc < tw) tile[tr * tw + tc] = va[b][h] > 0.5f ? e[b][h] : NAN;
        }
      }
    }
  }
  for (int t = threadIdx.y * FT_W + lane; t < m; t += FT_THREADS) {
    const int2 o = __ldg(tab + t);
    soff[t] = o.y * tw + o.x;
    if (KIND == kIDW) sw[t] = __ldg(wtab + t);
  }

  const int c = c0 + lane;
  int at[CPT], lim[CPT], cnt[CPT];
  float ws[CPT], vs[CPT], own[CPT];
  bool kept[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int lr = threadIdx.y + j * FT_TY;
    const int r = r0 + lr;
    const bool live = r < H && c < W;
    kept[j] = live && keep && __ldg(valid + (size_t)r * pv + c) > 0.5f;
    own[j] = kept[j] ? __ldg(elev + (size_t)r * pe + c) : 0.f;
    at[j] = (lr + R) * tw + lane + R;
    lim[j] = live && !kept[j] ? k : 0;  // a cell outside the plane or kept scans nothing
    cnt[j] = 0;
    ws[j] = 0.f;
    vs[j] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < m; ++t) {
    bool more = false;
#pragma unroll
    for (int j = 0; j < CPT; ++j) more = more || cnt[j] < lim[j];
    if (!more) break;
    const int so = soff[t];
    const float w = KIND == kIDW ? sw[t] : 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float v = tile[at[j] + so];
      if (cnt[j] < lim[j] && !isnan(v)) {
        if (KIND == kIDW) {
          ws[j] = ws[j] + w;
          vs[j] = vs[j] + w * v;
        } else {
          vs[j] = vs[j] + v;
        }
        ++cnt[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int r = r0 + threadIdx.y + j * FT_TY;
    if (r < H && c < W) {
      float res;
      if (KIND == kIDW)
        res = cnt[j] > 0 ? vs[j] / fmaxf(ws[j], eps) : NAN;
      else
        res = cnt[j] > 0 ? vs[j] / fmaxf((float)cnt[j], 1.f) : NAN;
      out[(size_t)r * W + c] = kept[j] ? own[j] : res;
    }
  }
}

template <int KIND, int CPT>
int launch_fill(const float* e, int pe, const float* va, int pv, const int2* t, const float* w,
                int m, int H, int W, int R, int k, float eps, int keep, float* o, cudaStream_t st) {
  constexpr int TH = FT_TY * CPT;
  const size_t smem = sizeof(float) * (size_t)(TH + 2 * R) * (FT_W + 2 * R) + 8 * (size_t)m;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fill_tile_kernel<KIND, CPT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 g((W + FT_W - 1) / FT_W, (H + TH - 1) / TH);
  fill_tile_kernel<KIND, CPT><<<g, dim3(FT_W, FT_TY), smem, st>>>(e, pe, va, pv, t, w, m, H, W, R, k,
                                                                   eps, keep, o);
  return (int)cudaGetLastError();
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

// elev, valid: (H, W) f32 planes with unit column stride and row pitches pe,
// pv (elements); tab: (m, 2) int32 (dx, dy) with |dx|, |dy| <= R; wtab: (m,)
// f32 IDW weights on the device (read only for kind 0); kind 0 = IDW, 1 =
// mean; eps: IDW's floor on the weight sum; keep: valid cells write their
// own elev; out: (H, W) f32, contiguous.  Any k >= 0 (no slots are kept).
// Four cells a thread (32x32 tiles, the least halo a cell) where the plane
// has the tiles to fill the card a few times over, two (32x16) otherwise: a
// 256x256 streaming window gets 128 blocks rather than 64.
int auvtpu_fill(const void* elev, int pe, const void* valid, int pv, const void* tab,
                const void* wtab, int m, int H, int W, int R, int kind, int k, float eps, int keep,
                void* out, void* stream) {
  if (kind < 0 || kind > 1 || R < 0 || m < 1 || k < 0) return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int cpt = (long long)((H + 31) / 32) * ((W + FT_W - 1) / FT_W) >= 4LL * sms ? 4 : 2;
  cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)elev;
  const float* va = (const float*)valid;
  const int2* t = (const int2*)tab;
  const float* w = (const float*)wtab;
  float* o = (float*)out;
  if (kind == kIDW)
    return cpt == 2 ? launch_fill<kIDW, 2>(e, pe, va, pv, t, w, m, H, W, R, k, eps, keep, o, st)
                    : launch_fill<kIDW, 4>(e, pe, va, pv, t, w, m, H, W, R, k, eps, keep, o, st);
  return cpt == 2 ? launch_fill<kMean, 2>(e, pe, va, pv, t, w, m, H, W, R, k, eps, keep, o, st)
                  : launch_fill<kMean, 4>(e, pe, va, pv, t, w, m, H, W, R, k, eps, keep, o, st);
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
