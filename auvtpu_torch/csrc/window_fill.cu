// Windowed first-k-valid selection and the fills built on it, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/window_fill.py.
//
// Replaces four TPU kernels of auvtpu/pallas/window_fill.py, and adds B19:
//   topk_tile_kernel<KCAP, CPT>  <- _make_topk_full_kernel    (B2, pallas_topk_full)
//   topk_idx_kernel<KCAP>        <- _make_topk_kernel         (B4, pallas_topk_idx)
//   kriging_fill_kernel          <- _make_kriging_fill_kernel (B1, pallas_fill_kriging)
//   kriging_cells_kernel         <- none: B1 at a list of cells (B19, below)
//   fill_tile_kernel<KIND, CPT>  <- _make_fill_kernel         (B3, pallas_fill_idw /
//                                                              pallas_fill_mean)
//
// What they compute.  Per output cell, scan a static window-offset table
// sorted by (distance^2, collection order) and keep the first k cells that
// are valid.  B2 writes (cnt, values, offsets); B4 writes (cnt, table
// indices), the slim form of the same selection; B1 goes on to build and
// solve the 5x6 ordinary-kriging system in registers (krige_solve.cuh, the
// solve B11 shares) and writes the prediction (and optionally the kriging
// variance); B3 folds each found cell
// into an inverse-distance-weighted sum (weights from a host table) or a
// plain mean, keeping no slots at all.  First-k-valid in a static order is a
// per-cell rule, so each thread stops as soon as its own cell is full and the
// answer is the same as the TPU's per-tile early exit.
//
// B4 reads one NaN-encoded plane (invalid and out-of-grid cells are NaN)
// that the wrapper builds, padded by R on every side so no read needs a
// bounds check.  B1, B2 and B3 read the elevation and validity planes as
// they are and build the NaN-encoded halo of each tile in shared memory
// themselves (halo_tile.cuh).  Slots are written with selects, and B3 adds
// only the values it takes, never hit * (v - old) or 0 * v arithmetic:
// 0 * NaN is NaN.
//
// What bounds them on the H100.  With 10-20% of cells masked a scan for 4
// neighbours reads 4.4-5.0 table rows per cell, one for 8 about 10 (measured
// at the Kerguelen stand-in).  B2 writes 1+3k planes and B4 1+k: both are
// bound by the output writes to HBM.  B3 reads two planes, writes one and
// does a few operations per candidate: it is bound by those bytes.  B1
// writes one plane (two with the variance) and does ~100 multiply-adds, 20
// divides (gj), 10 square roots and 10 exps per cell: it is bound by the
// issue of those ~1,000 instructions a cell, not by memory.  B4 does the
// simple thing: one thread per cell in 32x8 blocks, reads through the
// read-only data cache (__ldg) so a warp's 32 neighbouring loads of one
// offset coalesce, the offset table read by all threads of a warp at the
// same index (a broadcast), all state in registers.  B2 (topk_tile_kernel),
// B3 (fill_tile_kernel) and B1 (kriging_fill_kernel) take what it leaves:
// no padded copy (its four extra launches cost about the kernel's time
// again), the scan's dependent loads served from shared memory, where they
// were L1/L2 round trips, and several cells a thread so that those loads
// overlap.  The price is a second plane read (valid beside elev, where the
// padded copy was one NaN-encoded plane).  For B1, an issue-bound kernel,
// the halo costs instructions (the load, the table in shared memory) that
// the padded copy's launches paid for outside it: alone it is slower than
// the kernel on the padded plane, the call faster (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "halo_tile.cuh"
#include "krige_solve.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int KBY = 8;  // B1's warps a block

// First-k-valid scan.  `base` points at the cell's own position in the padded
// plane; tab[t] = (dx, dy).  Fills slots 0..cnt-1 with the table index of
// each selected cell and returns cnt.  The unrolled compare keeps the slots
// in registers (a dynamically indexed array would go to local memory).
template <int KCAP>
__device__ __forceinline__ int select_first_k(const float* __restrict__ base, int pitch,
                                              const int2* __restrict__ tab, int m, int k, int (&tix)[KCAP]) {
  int cnt = 0;
  for (int t = 0; t < m && cnt < k; ++t) {
    const int2 o = __ldg(tab + t);
    const float v = __ldg(base + o.y * pitch + o.x);
    if (!isnan(v)) {
#pragma unroll
      for (int s = 0; s < KCAP; ++s) {
        if (s == cnt) tix[s] = t;
      }
      ++cnt;
    }
  }
  return cnt;
}

// B4: out is (1+k, H, W) = cnt, table index of each slot as a float, -1 at
// an empty slot (pallas_topk_idx's planes), over the NaN-padded plane.
template <int KCAP>
__global__ void __launch_bounds__(BX * BY)
topk_idx_kernel(const float* __restrict__ nanp, const int2* __restrict__ tab, int m,
                int H, int W, int R, int k, float* __restrict__ out) {
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (r >= H || c >= W) return;
  const int pitch = W + 2 * R;
  const float* base = nanp + (size_t)(r + R) * pitch + (c + R);
  int tix[KCAP];
#pragma unroll
  for (int s = 0; s < KCAP; ++s) tix[s] = 0;
  const int cnt = select_first_k<KCAP>(base, pitch, tab, m, k, tix);

  const size_t plane = (size_t)H * W;
  const size_t cell = (size_t)r * W + c;
  out[cell] = (float)cnt;
#pragma unroll
  for (int s = 0; s < KCAP; ++s) {
    if (s < k) out[(1 + s) * plane + cell] = s < cnt ? (float)tix[s] : -1.f;
  }
}

// One output row segment of a warp, count <= 32 * CPX cells from dst on
// (lane l holds cells l, l + 32, ...), written with 16-byte stores: staged in
// the warp's buffer of 32 * CPX + 4 floats at dst's offset within 16 bytes,
// so that the span's 16-byte-aligned middle is read back as float4s, with a
// scalar head and tail (an output row at any 4-byte alignment: the planes'
// width is odd in general).  B2's writes are most of its bytes: with a
// 4-byte store a cell and plane it took 0.20 ms at the r0.10 stand-in, with
// these spans 0.18 at first (PERF.md).
template <int CPX>
__device__ __forceinline__ void write_row(float* __restrict__ dst, const float (&v)[CPX], float* __restrict__ buf,
                                          int count, int lane) {
  const int a = (int)(((uintptr_t)dst >> 2) & 3);
#pragma unroll
  for (int j = 0; j < CPX; ++j) buf[a + lane + 32 * j] = v[j];
  __syncwarp();
  const int head = min((4 - a) & 3, count);
  const int body = (count - head) >> 2;
  if (lane < head) dst[lane] = buf[a + lane];
  float4* const dst4 = reinterpret_cast<float4*>(dst + head);
  const float4* const buf4 = reinterpret_cast<const float4*>(buf + a + head);  // a + head is 0 or 4
  for (int i = lane; i < body; i += 32) dst4[i] = buf4[i];
  const int i = head + 4 * body + lane;
  if (i < count) dst[i] = buf[a + i];
  __syncwarp();
}

// B2: first-k-valid selection over a halo tile in shared memory
// (halo_tile.cuh), out (1+3k, H, W) = cnt, vals[k], dxs[k], dys[k].  One
// block of BX x BY threads fills a BX*CPX-column, BY-row tile of the output,
// CPX cells a thread (columns lane, lane + 32, ...; warp w on row w), four
// blocks an SM (launch bounds: 64 registers; at the 78 it took unbounded, 3
// blocks were 8 % slower):
//   1. the halo tile, the table as (dx, dy) and as each row's offset within
//      the tile;
//   2. per cell, the table rows of its first k valid cells in table order,
//      16 bits each, two to a register (m <= 65535): the CPX scans step
//      through the table together, so their shared loads overlap;
//   3. per plane, each warp's row of the tile written with write_row: the
//      value read back from the tile and the offset from the table, or value
//      0 and offset (-R, -R) at an empty slot (as pallas_topk_full's code -1
//      decodes; every consumer masks slots >= cnt).  The 1+3k planes (260 MB
//      at the r0.10 stand-in, k=4) are most of the kernel's bytes.
template <int KCAP, int CPX>
__global__ void __launch_bounds__(BX * BY, 4)
topk_tile_kernel(const float* __restrict__ elev, int pe, const float* __restrict__ valid, int pv,
                 const int2* __restrict__ tab, int m, int H, int W, int R, int k, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  constexpr int TW = BX * CPX;
  const int tw = TW + 2 * R;
  const int th = BY + 2 * R;
  float* const buf = reinterpret_cast<float*>(smem4) + threadIdx.y * (TW + 4);
  int2* stab = reinterpret_cast<int2*>(reinterpret_cast<float*>(smem4) + BY * (TW + 4));
  int* soff = reinterpret_cast<int*>(stab + m);
  float* tile = reinterpret_cast<float*>(soff + m);
  const int r0 = blockIdx.y * BY;
  const int c0 = blockIdx.x * TW;
  const int lane = threadIdx.x;
  const int r = r0 + threadIdx.y;
  load_halo_tile<BX, BY, 4>(tile, th, tw, r0, c0, R, elev, pe, valid, pv, H, W);
  for (int t = threadIdx.y * BX + lane; t < m; t += BX * BY) {
    const int2 o = __ldg(tab + t);
    stab[t] = o;
    soff[t] = o.y * tw + o.x;
  }

  int at[CPX], lim[CPX], cnt[CPX];
  unsigned slots[CPX][KCAP / 2];
#pragma unroll
  for (int j = 0; j < CPX; ++j) {
    at[j] = (threadIdx.y + R) * tw + lane + 32 * j + R;
    lim[j] = (r < H && c0 + lane + 32 * j < W) ? k : 0;  // a cell outside the plane scans nothing
    cnt[j] = 0;
#pragma unroll
    for (int w = 0; w < KCAP / 2; ++w) slots[j][w] = 0u;
  }
  __syncthreads();

  for (int t = 0; t < m; ++t) {
    bool more = false;
#pragma unroll
    for (int j = 0; j < CPX; ++j) more = more || cnt[j] < lim[j];
    if (!more) break;
    const int so = soff[t];
#pragma unroll
    for (int j = 0; j < CPX; ++j) {
      const float v = tile[at[j] + so];
      if (cnt[j] < lim[j] && !isnan(v)) {
        const unsigned row = (unsigned)t << (16 * (cnt[j] & 1));
#pragma unroll
        for (int w = 0; w < KCAP / 2; ++w) slots[j][w] |= w == (cnt[j] >> 1) ? row : 0u;
        ++cnt[j];
      }
    }
  }

  if (r >= H) return;  // the warp's row lies below the plane
  const int count = min(TW, W - c0);
  const size_t plane = (size_t)H * W;
  float* const row = out + (size_t)r * W + c0;
  float v[CPX];
#pragma unroll
  for (int j = 0; j < CPX; ++j) v[j] = (float)cnt[j];
  write_row<CPX>(row, v, buf, count, lane);
  // a slot's three planes one at a time, each cell's offset read again from
  // the table for each: CPX values live, not 3 * CPX
#pragma unroll
  for (int s = 0; s < KCAP; ++s) {
    if (s < k) {
#pragma unroll
      for (int part = 0; part < 3; ++part) {
#pragma unroll
        for (int j = 0; j < CPX; ++j) {
          const bool live = s < cnt[j];
          const int ts = (int)((slots[j][s >> 1] >> (16 * (s & 1))) & 0xffffu);
          const int2 d = live ? stab[ts] : make_int2(-R, -R);
          v[j] = part == 0 ? (live ? tile[at[j] + d.y * tw + d.x] : 0.f) : (float)(part == 1 ? d.x : d.y);
        }
        write_row<CPX>(row + (1 + part * k + s) * plane, v, buf, count, lane);
      }
    }
  }
}

template <int KCAP, int CPX>
int launch_topk_tile(cudaStream_t st, const float* e, int pe, const float* va, int pv, const int2* tab, int m,
                     int H, int W, int R, int k, float* out) {
  constexpr int TW = BX * CPX;
  const size_t smem = sizeof(float) * (size_t)BY * (TW + 4) + 12 * (size_t)m +
                      sizeof(float) * (size_t)(BY + 2 * R) * (TW + 2 * R);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(topk_tile_kernel<KCAP, CPX>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 g((W + TW - 1) / TW, (H + BY - 1) / BY);
  topk_tile_kernel<KCAP, CPX><<<g, dim3(BX, BY), smem, st>>>(e, pe, va, pv, tab, m, H, W, R, k, out);
  return (int)cudaGetLastError();
}

// The fixed parameters of a B1 launch, by value (window_fill.py:884-891).
// The variogram's (nugget, sill, range) are read through p_vario where it is
// not null (fitted parameters: three f32 on the device, which never travel
// to the host), else taken from vario.
struct KrigingParams {
  float min_lon, min_lat, lon_step, lat_step, half, pivot_tol, row0, col0;
  float vario[3];
  const float* p_vario[3];
};

// One cell's kriging inputs: its cnt <= 4 found neighbours (value vz,
// centre cx, cy in degrees; empty slots hold 0 and the (-R, -R) offset) and
// the query point.
struct CellIn {
  float vz[4], cx[4], cy[4];
  float qlon, qlat;
  int cnt;
};

// One cell's kriging (krige_solve.cuh): the prediction (the neighbour mean
// where fewer than 4 were found or a pivot fell below pivot_tol; NaN where
// none was found) and, with VAR, the variance into var.  The diagonal is
// the nugget, as the Pallas kernel writes it.
template <int MODEL, int SOLVER, bool VAR>
__device__ __forceinline__ float krige_cell(const CellIn& in, float nugget, float sill, float vrange,
                                            float pivot_tol, float& var) {
  const int cnt = in.cnt;
  const float(&vz)[4] = in.vz;
  float lam[5], gamma0[4];
  const bool singular = krige_solve<SOLVER>(
      in.cx, in.cy, in.qlon, in.qlat, nugget,
      [&](float h) { return gamma_fn<MODEL>(h, nugget, sill, vrange); }, pivot_tol, lam, gamma0);

  const float pr = lam[0] * vz[0] + lam[1] * vz[1] + lam[2] * vz[2] + lam[3] * vz[3];
  const float fbs = vz[0] + vz[1] + vz[2] + vz[3];
  const float fb = cnt > 0 ? fbs / fmaxf((float)cnt, 1.f) : NAN;
  const bool bail = singular || cnt < 4;
  if (VAR) {
    // sigma^2 = sum_i w_i gamma_i0 + mu, clamped at 0 (a NaN stays NaN);
    // fallback cells have no defined variance
    float v = lam[0] * gamma0[0];
    v = v + lam[1] * gamma0[1];
    v = v + lam[2] * gamma0[2];
    v = v + lam[3] * gamma0[3];
    v = v + lam[4];
    v = v < 0.f ? 0.f : v;
    var = bail ? NAN : v;
  }
  return bail ? fb : pr;
}

// One cell's kriging at (r, c), row0/col0 placing it in a larger grid,
// from its cnt <= 4 found neighbours: the table row t of slot s is bits
// 16s.. of slots, a live slot (s < cnt) lies at offset off(t) with value
// val(t, s), an empty one at (-R, -R) with value 0.  Returns (prediction,
// variance).  B1 and B19 both solve through here, so that their answers
// cannot drift apart.
template <int MODEL, int SOLVER, bool VAR, class Off, class Val>
__device__ __forceinline__ float2 krige_at(int r, int c, int cnt, unsigned long long slots, int R,
                                           const KrigingParams& P, float nugget, float sill, float vrange, Off off,
                                           Val val) {
  CellIn in;
  in.cnt = cnt;
  // Absolute f32 degrees first, differences after: the cancellation is
  // part of the reference answer (integers < 2^24 make col + col0 exact).
  const float colf = (float)c + P.col0;
  const float rowf = (float)r + P.row0;
  in.qlon = P.min_lon + colf * P.lon_step;
  in.qlat = P.min_lat + rowf * P.lat_step;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool live = s < in.cnt;
    const int ts = (int)((slots >> (16 * s)) & 0xffffu);
    const int2 o = live ? off(ts) : make_int2(-R, -R);
    in.cx[s] = P.min_lon + ((colf + (float)o.x) + P.half) * P.lon_step;
    in.cy[s] = P.min_lat + ((rowf + (float)o.y) + P.half) * P.lat_step;
    in.vz[s] = live ? val(ts, s) : 0.f;
  }
  float var = 0.f;
  const float pred = krige_cell<MODEL, SOLVER, VAR>(in, nugget, sill, vrange, P.pivot_tol, var);
  return make_float2(pred, var);
}

// B1: first-4-valid selection and the kriging solve per cell, over a halo
// tile in shared memory (halo_tile.cuh).  One block of BX x KBY threads
// fills a BX-column, KBY*CPT-row tile of the output, CPT cells a thread
// (rows ty, ty + KBY, ...): the CPT scans step through the table together,
// as B3's do, so their shared loads overlap; then each cell is solved in
// registers, one copy of the solve for the thread's cells.
template <int MODEL, int SOLVER, bool VAR, int CPT>
__global__ void __launch_bounds__(BX * KBY)
kriging_fill_kernel(const float* __restrict__ elev, int pe, const float* __restrict__ valid, int pv,
                    const int2* __restrict__ tab, int m, int H, int W, int R, KrigingParams P,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int TH = KBY * CPT;
  const int tw = BX + 2 * R;
  const int th = TH + 2 * R;
  float* tile = smem;
  // the table as (dx, dy) and as each row's offset within the tile: the
  // solve reads a slot's offsets here, where a global read would be an L2
  // round trip at the start of every cell's solve
  int2* stab = reinterpret_cast<int2*>(tile + ((th * tw + 1) & ~1));
  int* soff = reinterpret_cast<int*>(stab + m);
  // each cell's scan result, so that the solve holds one cell's in
  // registers: 48 of them, five 256-thread blocks an SM
  constexpr int NT = BX * KBY;
  unsigned long long* sslots = reinterpret_cast<unsigned long long*>(soff + ((m + 1) & ~1));
  int* scnt = reinterpret_cast<int*>(sslots + CPT * NT);
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * BX;
  const int lane = threadIdx.x;
  load_halo_tile<BX, KBY, 4>(tile, th, tw, r0, c0, R, elev, pe, valid, pv, H, W);
  for (int t = threadIdx.y * BX + lane; t < m; t += BX * KBY) {
    const int2 o = __ldg(tab + t);
    stab[t] = o;
    soff[t] = o.y * tw + o.x;
  }
  const float nugget = P.p_vario[0] ? __ldg(P.p_vario[0]) : P.vario[0];
  const float sill = P.p_vario[1] ? __ldg(P.p_vario[1]) : P.vario[1];
  const float vrange = P.p_vario[2] ? __ldg(P.p_vario[2]) : P.vario[2];
  const int c = c0 + lane;
  // a cell's slots as the table rows of its first four valid cells, 16 bits
  // each (m <= 65535): a shift and an or a find, where a slot array would
  // take a compare and two selects a slot; the values are read back from
  // the tile, which stays in place until the block ends
  int at[CPT], lim[CPT], cnt[CPT];
  unsigned long long slots[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int lr = threadIdx.y + j * KBY;
    at[j] = (lr + R) * tw + lane + R;
    lim[j] = (r0 + lr < H && c < W) ? 4 : 0;  // a cell outside the plane scans nothing
    cnt[j] = 0;
    slots[j] = 0ull;
  }
  __syncthreads();

  // first 4 valid cells in table order
  for (int t = 0; t < m; ++t) {
    bool more = false;
#pragma unroll
    for (int j = 0; j < CPT; ++j) more = more || cnt[j] < lim[j];
    if (!more) break;
    const int so = soff[t];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float v = tile[at[j] + so];
      if (cnt[j] < lim[j] && !isnan(v)) {
        slots[j] |= (unsigned long long)t << (16 * cnt[j]);
        ++cnt[j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    sslots[j * NT + tid] = slots[j];
    scnt[j * NT + tid] = cnt[j];
  }

  const size_t plane = (size_t)H * W;
#pragma unroll 1
  for (int j = 0; j < CPT; ++j) {
    const int r = r0 + threadIdx.y + j * KBY;
    if (r >= H || c >= W) continue;
    const int cj = scnt[j * NT + tid];
    const int aj = (threadIdx.y + j * KBY + R) * tw + lane + R;
    const unsigned long long sj = sslots[j * NT + tid];
    const float2 pv = krige_at<MODEL, SOLVER, VAR>(r, c, cj, sj, R, P, nugget, sill, vrange,
                                                   [&](int t) { return stab[t]; },
                                                   [&](int t, int) { return tile[aj + soff[t]]; });
    const size_t cell = (size_t)r * W + c;
    out[cell] = pv.x;
    if (VAR) out[plane + cell] = pv.y;
  }
}

// B19: B1 at a list of cells, for kriging at the masked cells of a tile
// (ops.dense.kriging_at_cells), where B1 solves every cell of the plane and
// the call keeps a tenth of them.  Replaces no Pallas kernel: on the TPU
// the JAX package takes the whole plane from B1 and gathers the cells (its
// random take costs ~30 ns an element there, the whole plane less); on the
// H100 both planes of a tile (40 MB at 2053 x 2441) fit in the 50 MB L2
// and a thread reads its own cell's neighbourhood at sector grain.
//
// One thread a listed cell, in list order, so every lane of a warp solves
// (the cells of a mask lie all over the tile; a pass in tile order would
// leave nine lanes in ten idle).  The table is staged once a block in
// shared memory (each lane reads the same row: a broadcast).  The scan
// (scan_cell) tests validity alone, with an in-grid test in place of B1's
// halo; the four found cells' elevations are read after it.  A found
// elevation that is NaN (a valid cell that B1's halo tile holds as NaN, so
// no neighbour) sends the cell through the scan again, testing both as B1
// does.  Then krige_at, as B1 solves; the answer is written at the cell's
// position in the list (coalesced).  A cell outside the grid reads nothing
// and gets NaN.  What bounds it is the memory system's service of scattered
// sectors: a scan that read both planes at every row took 0.077 ms at the
// stand-in's 501,137 masked cells, this one 0.056; reading the 3 x 3
// block's validity in 16-byte loads first (4.5 loads for 8) saved 1 % there
// and cost 13 % at every cell (PERF.md).
constexpr int CT = 256;  // B19's threads a block
constexpr int CB = 4;    // table rows a batch of B19's scan

// B19's scan of cell (r, c): the table rows of its first four valid cells
// in table order into slots, 16 bits each, and their count.  CB rows a
// batch, every load of a batch issued before the first is tested (they
// are L2 round trips, and one at a time left the thread waiting on each).
// ELEV: valid as in B1's halo tile (valid > 0.5 and the elevation not
// NaN), the found elevations into vz; else valid > 0.5 alone.
template <bool ELEV>
__device__ __forceinline__ int scan_cell(const float* __restrict__ elev, int pe, const float* __restrict__ valid,
                                         int pv, const int2* ctab, int m, int H, int W, int r, int c,
                                         unsigned long long& slots, float (&vz)[4]) {
  int cnt = 0;
  slots = 0ull;
  for (int t0 = 0; t0 < m && cnt < 4; t0 += CB) {
    float v[CB];
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int t = t0 + b;
      const int2 o = t < m ? ctab[t] : make_int2(0, 0);
      const int gr = r + o.y;
      const int gc = c + o.x;
      const bool in = t < m && gr >= 0 && gr < H && gc >= 0 && gc < W;
      const float va = in ? __ldg(valid + (size_t)gr * pv + gc) : 0.f;
      const float e = ELEV && in ? __ldg(elev + (size_t)gr * pe + gc) : 0.f;
      v[b] = va > 0.5f ? e : NAN;
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      if (cnt < 4 && !isnan(v[b])) {
        slots |= (unsigned long long)(t0 + b) << (16 * cnt);
#pragma unroll
        for (int s = 0; s < 4; ++s) vz[s] = s == cnt ? v[b] : vz[s];
        ++cnt;
      }
    }
  }
  return cnt;
}

template <int MODEL, int SOLVER>
__global__ void __launch_bounds__(CT)
kriging_cells_kernel(const float* __restrict__ elev, int pe, const float* __restrict__ valid, int pv,
                     const int2* __restrict__ tab, int m, int H, int W, int R, KrigingParams P,
                     const long long* __restrict__ rows, const long long* __restrict__ cols, long long n,
                     float* __restrict__ out) {
  extern __shared__ int2 ctab[];
  for (int t = threadIdx.x; t < m; t += CT) ctab[t] = __ldg(tab + t);
  const long long i = (long long)blockIdx.x * CT + threadIdx.x;
  const long long r64 = i < n ? __ldg(rows + i) : -1;
  const long long c64 = i < n ? __ldg(cols + i) : -1;
  const float nugget = P.p_vario[0] ? __ldg(P.p_vario[0]) : P.vario[0];
  const float sill = P.p_vario[1] ? __ldg(P.p_vario[1]) : P.vario[1];
  const float vrange = P.p_vario[2] ? __ldg(P.p_vario[2]) : P.vario[2];
  __syncthreads();
  if (i >= n) return;
  if (r64 < 0 || r64 >= H || c64 < 0 || c64 >= W) {
    out[i] = NAN;
    return;
  }
  const int r = (int)r64;
  const int c = (int)c64;
  unsigned long long slots;
  float vz[4] = {0.f, 0.f, 0.f, 0.f};
  int cnt = scan_cell<false>(elev, pe, valid, pv, ctab, m, H, W, r, c, slots, vz);
  bool nan_value = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < cnt) {
      const int2 o = ctab[(slots >> (16 * s)) & 0xffffu];
      vz[s] = __ldg(elev + (size_t)(r + o.y) * pe + (c + o.x));
      nan_value = nan_value || isnan(vz[s]);
    }
  }
  if (nan_value) cnt = scan_cell<true>(elev, pe, valid, pv, ctab, m, H, W, r, c, slots, vz);
  out[i] = krige_at<MODEL, SOLVER, false>(r, c, cnt, slots, R, P, nugget, sill, vrange,
                                          [&](int t) { return ctab[t]; }, [&](int, int s) { return vz[s]; }).x;
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

  load_halo_tile<FT_W, FT_TY, FT_ROWS>(tile, th, tw, r0, c0, R, elev, pe, valid, pv, H, W);
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

template <int MODEL, int SOLVER, bool VAR, int CPT>
int launch_kriging(dim3 g, cudaStream_t st, const float* e, int pe, const float* va, int pv,
                   const int2* tab, int m, int H, int W, int R, const KrigingParams& par, float* out) {
  const size_t tsz = (size_t)(KBY * CPT + 2 * R) * (BX + 2 * R);
  const size_t smem = sizeof(float) * ((tsz + 1) & ~(size_t)1) + 8 * (size_t)m + 4 * (size_t)((m + 1) & ~1) +
                      12 * (size_t)(CPT * BX * KBY);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kriging_fill_kernel<MODEL, SOLVER, VAR, CPT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kriging_fill_kernel<MODEL, SOLVER, VAR, CPT><<<g, dim3(BX, KBY), smem, st>>>(e, pe, va, pv, tab, m, H, W, R,
                                                                              par, out);
  return (int)cudaGetLastError();
}

template <int MODEL, int SOLVER, int CPT>
int launch_kriging_var(bool var, dim3 g, cudaStream_t st, const float* e, int pe, const float* va,
                       int pv, const int2* tab, int m, int H, int W, int R, const KrigingParams& par,
                       float* out) {
  return var ? launch_kriging<MODEL, SOLVER, true, CPT>(g, st, e, pe, va, pv, tab, m, H, W, R, par, out)
             : launch_kriging<MODEL, SOLVER, false, CPT>(g, st, e, pe, va, pv, tab, m, H, W, R, par, out);
}

template <int MODEL, int CPT>
int launch_kriging_solver(int solver, bool var, dim3 g, cudaStream_t st, const float* e, int pe,
                          const float* va, int pv, const int2* tab, int m, int H, int W, int R,
                          const KrigingParams& par, float* out) {
  return solver == kGJ
             ? launch_kriging_var<MODEL, kGJ, CPT>(var, g, st, e, pe, va, pv, tab, m, H, W, R, par, out)
             : launch_kriging_var<MODEL, kLU, CPT>(var, g, st, e, pe, va, pv, tab, m, H, W, R, par, out);
}

template <int CPT>
int launch_kriging_model(int model, int solver, bool var, cudaStream_t st, const float* e, int pe,
                         const float* va, int pv, const int2* tab, int m, int H, int W, int R,
                         const KrigingParams& par, float* out) {
  const dim3 g((W + BX - 1) / BX, (H + KBY * CPT - 1) / (KBY * CPT));
  switch (model) {
    case kExponential:
      return launch_kriging_solver<kExponential, CPT>(solver, var, g, st, e, pe, va, pv, tab, m, H, W, R, par, out);
    case kLinear:
      return launch_kriging_solver<kLinear, CPT>(solver, var, g, st, e, pe, va, pv, tab, m, H, W, R, par, out);
    case kSpherical:
      return launch_kriging_solver<kSpherical, CPT>(solver, var, g, st, e, pe, va, pv, tab, m, H, W, R, par, out);
    default:
      return launch_kriging_solver<kGaussian, CPT>(solver, var, g, st, e, pe, va, pv, tab, m, H, W, R, par, out);
  }
}

template <int MODEL, int SOLVER>
int launch_cells(cudaStream_t st, const float* e, int pe, const float* va, int pv, const int2* tab, int m, int H,
                 int W, int R, const KrigingParams& par, const long long* rows, const long long* cols, long long n,
                 float* out) {
  const size_t smem = sizeof(int2) * (size_t)m;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kriging_cells_kernel<MODEL, SOLVER>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n + CT - 1) / CT);
  kriging_cells_kernel<MODEL, SOLVER><<<blocks, CT, smem, st>>>(e, pe, va, pv, tab, m, H, W, R, par, rows, cols,
                                                                 n, out);
  return (int)cudaGetLastError();
}

template <int MODEL>
int launch_cells_solver(int solver, cudaStream_t st, const float* e, int pe, const float* va, int pv,
                        const int2* tab, int m, int H, int W, int R, const KrigingParams& par,
                        const long long* rows, const long long* cols, long long n, float* out) {
  return solver == kGJ ? launch_cells<MODEL, kGJ>(st, e, pe, va, pv, tab, m, H, W, R, par, rows, cols, n, out)
                       : launch_cells<MODEL, kLU>(st, e, pe, va, pv, tab, m, H, W, R, par, rows, cols, n, out);
}

// B1's and B19's parameters from the C entries' geo and vario arrays and
// the variogram's device pointers.
KrigingParams kriging_params(const float* geo, const float* vario, const void* p_nugget, const void* p_sill,
                             const void* p_range) {
  KrigingParams par;
  par.min_lon = geo[0];
  par.min_lat = geo[1];
  par.lon_step = geo[2];
  par.lat_step = geo[3];
  par.half = geo[4];
  par.pivot_tol = geo[5];
  par.row0 = geo[6];
  par.col0 = geo[7];
  const void* ptrs[3] = {p_nugget, p_sill, p_range};
  for (int i = 0; i < 3; ++i) {
    par.vario[i] = vario[i];
    par.p_vario[i] = (const float*)ptrs[i];
  }
  return par;
}

}  // namespace

extern "C" {

// B2.  elev, valid: (H, W) f32 planes with unit column stride and row
// pitches pe, pv (elements), read as they are; tab: (m, 2) int32 (dx, dy)
// with |dx|, |dy| <= R, m <= 65535; out: (1+3k, H, W) f32 = cnt, vals[k],
// dxs[k], dys[k], contiguous.  1 <= k <= 16.  Where the plane has the tiles
// for two blocks an SM, eight cells a thread for k <= 4 (256x8 tiles: the
// longest row spans, the least halo a cell; 8 was 5 % faster than 4, 2
// was 14 % slower, PERF.md) and two for k > 4 (sixteen slots a cell take the
// registers); one (32x8) otherwise.  One kernel launch, nothing else on the
// stream.
int auvtpu_topk_full(const void* elev, int pe, const void* valid, int pv, const void* tab, int m, int H, int W,
                     int R, int k, void* out, void* stream) {
  if (k < 1 || k > 16 || R < 0 || m < 1 || m > 65535) return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int cpx = k <= 4 ? 8 : 2;
  const bool wide = (long long)((W + cpx * BX - 1) / (cpx * BX)) * ((H + BY - 1) / BY) >= 2LL * sms;
  cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)elev;
  const float* va = (const float*)valid;
  const int2* t = (const int2*)tab;
  float* o = (float*)out;
  if (k <= 4)
    return wide ? launch_topk_tile<4, 8>(st, e, pe, va, pv, t, m, H, W, R, k, o)
                : launch_topk_tile<4, 1>(st, e, pe, va, pv, t, m, H, W, R, k, o);
  return wide ? launch_topk_tile<16, 2>(st, e, pe, va, pv, t, m, H, W, R, k, o)
              : launch_topk_tile<16, 1>(st, e, pe, va, pv, t, m, H, W, R, k, o);
}

// B4.  nanp: (H+2R, W+2R) f32, NaN = invalid; tab: (m, 2) int32 (dx, dy);
// out: (1+k, H, W) f32 = cnt, slot table indices (-1 = empty).  1 <= k <= 16.
int auvtpu_topk_idx(const void* nanp, const void* tab, int m, int H, int W, int R, int k,
                    void* out, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  const dim3 b(BX, BY);
  const dim3 g((W + BX - 1) / BX, (H + BY - 1) / BY);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)nanp;
  const int2* t = (const int2*)tab;
  float* o = (float*)out;
  if (k <= 4)
    topk_idx_kernel<4><<<g, b, 0, st>>>(p, t, m, H, W, R, k, o);
  else
    topk_idx_kernel<16><<<g, b, 0, st>>>(p, t, m, H, W, R, k, o);
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

// elev, valid: (H, W) f32 planes with unit column stride and row pitches pe,
// pv (as for auvtpu_fill); tab: (m, 2) int32 (dx, dy), |dx|, |dy| <= R;
// geo: min_lon, min_lat, lon_step, lat_step, half, pivot_tol, row0, col0 (8
// f32 on the host, passed by value); vario: nugget, sill, range (3 f32 on
// the host), each replaced by *p_nugget, *p_sill, *p_range (one f32 on the
// device) where that pointer is not null; model 0..3 (exponential, linear,
// spherical, gaussian); solver 0 = gj, 1 = lu;
// out: (H, W) f32, or (2, H, W) with the variance plane second; contiguous.
// One kernel launch, nothing else on the stream.
int auvtpu_kriging_fill(const void* elev, int pe, const void* valid, int pv, const void* tab, int m, int H,
                        int W, int R, const float* geo, const float* vario, const void* p_nugget,
                        const void* p_sill, const void* p_range, int model, int solver, int with_variance,
                        void* out, void* stream) {
  if (model < 0 || model > 3 || solver < 0 || solver > 1 || R < 0 || m < 1 || m > 65535)
    return (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  // four cells a thread (the least halo a cell) where the plane has the
  // tiles for two blocks an SM, one otherwise: a 256x256 streaming window
  // gets 256 blocks rather than 64
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool four = (long long)((W + BX - 1) / BX) * ((H + 4 * KBY - 1) / (4 * KBY)) >= 2LL * sms;
  const KrigingParams par = kriging_params(geo, vario, p_nugget, p_sill, p_range);
  cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)elev;
  const float* va = (const float*)valid;
  const int2* t = (const int2*)tab;
  float* o = (float*)out;
  const bool var = with_variance != 0;
  return four ? launch_kriging_model<4>(model, solver, var, st, e, pe, va, pv, t, m, H, W, R, par, o)
              : launch_kriging_model<1>(model, solver, var, st, e, pe, va, pv, t, m, H, W, R, par, o);
}

// B19.  elev, valid, tab, geo, vario, p_nugget, p_sill, p_range, model and
// solver as for auvtpu_kriging_fill (geo's row0 and col0 place the cells
// in a larger grid as they place the plane); rows, cols: (n,) int64 cells,
// read as they come; out: (n,) f32, the kriging plane's value at each cell
// (bit-equal to auvtpu_kriging_fill's plane there), NaN at a cell outside
// the (H, W) grid.  Any order, duplicates allowed.  One kernel launch,
// nothing else on the stream.
int auvtpu_kriging_cells(const void* elev, int pe, const void* valid, int pv, const void* tab, int m, int H,
                         int W, int R, const float* geo, const float* vario, const void* p_nugget,
                         const void* p_sill, const void* p_range, int model, int solver, const void* rows,
                         const void* cols, long long n, void* out, void* stream) {
  if (model < 0 || model > 3 || solver < 0 || solver > 1 || R < 0 || m < 1 || m > 65535 || n < 0 ||
      (n + CT - 1) / CT > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const KrigingParams par = kriging_params(geo, vario, p_nugget, p_sill, p_range);
  cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)elev;
  const float* va = (const float*)valid;
  const int2* t = (const int2*)tab;
  const long long* rs = (const long long*)rows;
  const long long* cs = (const long long*)cols;
  float* o = (float*)out;
  switch (model) {
    case kExponential:
      return launch_cells_solver<kExponential>(solver, st, e, pe, va, pv, t, m, H, W, R, par, rs, cs, n, o);
    case kLinear:
      return launch_cells_solver<kLinear>(solver, st, e, pe, va, pv, t, m, H, W, R, par, rs, cs, n, o);
    case kSpherical:
      return launch_cells_solver<kSpherical>(solver, st, e, pe, va, pv, t, m, H, W, R, par, rs, cs, n, o);
    default:
      return launch_cells_solver<kGaussian>(solver, st, e, pe, va, pv, t, m, H, W, R, par, rs, cs, n, o);
  }
}

const char* auvtpu_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
